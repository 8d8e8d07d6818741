"""The port's ``moe`` algo (``MixtureOfExperts``) against the JAX
package's, on the same parameters (random, from a numpy seed) and inputs.

Tolerances: forward fp32 max abs diff <= 1e-5.  bf16 (parameters and
inputs cast, the JAX package's ``compute_dtype``): the two packages round
at different points (XLA fuses the dense products with the activation and
keeps them unrounded; at outputs up to ~11 the JAX package's bf16 dense
forward lies 0.41 from the fp32 forward of the same bf16 values, the
port's 0.05), so the port is held to that fp32 forward within
``BF16_REL`` x its largest value, and to the JAX package's output within
the JAX output's own distance from it plus that tolerance.  Gradients of
every parameter, the cost with its auxiliary load-balance loss and the
``router_fraction`` buffer (fp32): <= 1e-5, relative or absolute as
stated at each test.  Greedy
tokens and ``decode_mixed_step`` samples are compared exactly.

Covered: both dispatch modes, with and without the shared expert and
``norm_topk``; capacity dispatch over two groups with padding and dropped
tokens; a tie in the router probabilities; a two-micro-step epoch;
checkpoints both ways and the migration of one written without the
buffer; greedy tokens on the contiguous, paged and int8 caches; one packed
block of the continuous-batching step in capacity mode; ``/stats/``'s
``moe_router_fractions``."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models import dsl as jdsl
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import CompiledArch as JArch
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.ops import modules as JM
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models.convert import as_tensor, from_jax_state_dict
from penroz_tpu_torch.models.dsl import build_optimizer
from penroz_tpu_torch.models.model import CompiledArch as TArch
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.ops import modules as TM
from penroz_tpu_torch.serve.app import create_app
from penroz_tpu_torch.utils import checkpoint as tckpt

FWD_ATOL = 1e-5
BF16_REL = 2.0 ** -6  # a few bf16 roundings of the largest value
D, E, H = 16, 6, 12
# B 2 x T 300 = 600 tokens: two dispatch groups of 512, the second padded
# with 424 rows; capacity ceil(2 * 512 / 6 * 0.6) = 103 a group drops
# tokens of the busier experts.
SHAPE = (2, 300, D)


def _moe(dispatch="dense", shared=0, norm_topk=True, aux=0.01,
         capacity_factor=0.6, **kw):
    return {"moe": {"in_features": D, "intermediate_size": H,
                    "num_experts": E, "top_k": 2, "dispatch": dispatch,
                    "capacity_factor": capacity_factor,
                    "norm_topk": norm_topk, "shared_expert_size": shared,
                    "aux_loss_coef": aux, **kw}}


VARIANTS = {
    "dense": _moe(),
    "capacity": _moe("capacity"),
    "dense_shared_raw_topk": _moe(shared=24, norm_topk=False),
    "capacity_shared_raw_topk": _moe("capacity", shared=24,
                                     norm_topk=False),
}


def _setup(layers, seed=0, scale=0.3):
    """(JAX arch, params, buffers, port arch) with the same random
    parameters."""
    rng = np.random.default_rng(seed)
    jarch = JArch(layers)
    params, buffers = jdsl.init_module_params(jarch.mods, seed)
    params = {k: jnp.asarray((rng.normal(size=v.shape) * scale)
                             .astype(np.float32)) for k, v in params.items()}
    tarch = TArch(layers)
    state = {k: as_tensor(np.asarray(v)) for k, v in params.items()}
    state.update({k: as_tensor(np.asarray(v)) for k, v in buffers.items()})
    tarch.load_state_dict(state, strict=True)
    return jarch, params, dict(buffers), tarch


def _x(seed=1, shape=SHAPE):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_jax(name, dtype):
    layers = [VARIANTS[name]]
    jarch, params, buffers, tarch = _setup(layers)
    assert [k for k, _ in tarch.named_parameters()] == jarch.param_order
    x = _x()
    compute = None if dtype == "float32" else jnp.bfloat16
    acts, _, _, _ = jarch.forward(params, buffers,
                                  jnp.asarray(x, jnp.dtype(dtype)),
                                  compute_dtype=compute)
    tdtype = getattr(torch, dtype)
    tparams = {k: p.detach().to(tdtype) for k, p in tarch.named_parameters()}
    tx = torch.as_tensor(x).to(tdtype)
    with torch.no_grad():
        tacts, _, _ = torch.func.functional_call(tarch, tparams, (tx,))
    got = tacts[-1].float().numpy()
    want = np.asarray(acts[-1], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
        return
    with torch.no_grad():  # fp32 math on the same bf16 values
        exact, _, _ = torch.func.functional_call(
            tarch, {k: p.float() for k, p in tparams.items()},
            (tx.float(),))
    exact = exact[-1].numpy()
    tol = BF16_REL * np.abs(exact).max()
    assert np.abs(got - exact).max() <= tol
    assert np.abs(got - want).max() <= np.abs(want - exact).max() + tol


def test_capacity_drops_tokens_in_padded_groups(monkeypatch):
    """The capacity case runs two groups, pads the second, and drops
    tokens past the capacity; the same drops as JAX's plan."""
    jarch, params, buffers, tarch = _setup([VARIANTS["capacity"]])
    seen = []
    plan = TM.MixtureOfExperts._dispatch_plan

    def spy(gw, cap, dtype):
        disp, combine = plan(gw, cap, dtype)
        seen.append((gw, cap, disp))
        return disp, combine

    monkeypatch.setattr(TM.MixtureOfExperts, "_dispatch_plan",
                        staticmethod(spy))
    with torch.no_grad():
        tarch(torch.as_tensor(_x()))
    (gw, cap, disp), = seen
    assert gw.shape == (2, 512, E) and cap == 103
    assert not gw[1, 600 - 512:].any()          # the padding rows
    selected = int((gw > 0).sum())
    assert selected == 2 * 600 and int(disp.sum()) < selected
    jdisp, _ = JM.MixtureOfExperts._dispatch_plan(
        jnp.asarray(gw.numpy()), cap, jnp.float32)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))


def test_router_tie_chosen_like_jax():
    """Experts 1, 3 and 4 have the same router row, so their probabilities
    are equal for every token: top-2 must take the lower indices (1, 3),
    as ``jax.lax.top_k`` does."""
    layers = [_moe(norm_topk=False)]
    jarch, params, buffers, tarch = _setup(layers)
    router = np.asarray(params["layers.0.router.weight"]).copy()
    router[[3, 4]] = router[1]
    router[[0, 2, 5]] *= 0.1
    params["layers.0.router.weight"] = jnp.asarray(router)
    with torch.no_grad():
        tarch.layers[0].router.weight.copy_(torch.as_tensor(router))
    x = np.abs(_x(shape=(1, 40, D)))
    x[..., :] *= np.sign(router[1])  # the shared row's logit is largest
    jmod = jarch.mods[0]
    jw = jmod.router_weights(jnp.asarray(x), JM.Ctx(params))
    with torch.no_grad():
        tw = tarch.layers[0].router_weights(torch.as_tensor(x), TM.Ctx())
    for w in (tw.numpy(), np.asarray(jw)):
        assert (w[..., [1, 3]] > 0).all() and not w[..., 4].any()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gradients_and_aux_cost_match_jax(name):
    """A training forward's MSE cost with its load-balance term, and every
    parameter's gradient (fp32, <= 1e-5 absolute)."""
    layers = [VARIANTS[name]]
    jarch, params, buffers, tarch = _setup(layers)
    x, y = _x(), _x(seed=2)
    rng = jax.random.key(0)

    def loss(p):
        _, cost, _, _ = jarch.forward(p, buffers, jnp.asarray(x),
                                      jnp.asarray(y), training=True, rng=rng)
        return cost

    jcost, jgrads = jax.value_and_grad(loss)(params)
    _, tcost, _ = tarch(torch.as_tensor(x), torch.as_tensor(y),
                        training=True)
    tcost.backward()
    np.testing.assert_allclose(float(tcost.detach()), float(jcost), rtol=1e-6)
    with torch.no_grad():
        _, plain, _ = tarch(torch.as_tensor(x), torch.as_tensor(y))
    # the aux term rides along
    assert float(tcost.detach()) - float(plain) > 0.005
    for key, p in tarch.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


def _moe_lm(dispatch="dense", vocab=64, **kw):
    """A two-block token model whose MLPs are ``moe`` layers."""
    d = 16

    def block():
        return {"residual": [
            {"sequential": [
                {"rmsnorm": {"normalized_shape": d}},
                {"linear": {"in_features": d, "out_features": 3 * d}},
                {"attention": {"num_heads": 4, "rope_theta": 10000.0}},
                {"linear": {"in_features": d, "out_features": d}}]},
            {"sequential": [
                {"rmsnorm": {"normalized_shape": d}},
                {"moe": {"in_features": d, "intermediate_size": 24,
                         "num_experts": 4, "top_k": 2,
                         "dispatch": dispatch, "aux_loss_coef": 0.02,
                         **kw}}]}]}

    return ([{"embedding": {"num_embeddings": vocab, "embedding_dim": d}},
             block(), block(),
             {"rmsnorm": {"normalized_shape": d}},
             {"linear": {"in_features": d, "out_features": vocab,
                         "bias": False}},
             {"softmaxlast": {"dim": -1}}])


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_epoch_of_two_micro_steps_matches_jax(dispatch):
    """One SGD epoch of two micro-steps (cross-entropy + aux): the cost,
    every parameter and each layer's ``router_fraction`` — the second
    micro-step's — as the JAX package's epoch gives them.  (SGD keeps the
    parameters' difference the learning rate times the gradients'; Adam's
    first step would scale a gradient of ~1e-8 to a full step.)"""
    layers = _moe_lm(dispatch, capacity_factor=0.5)
    sgd = {"sgd": {"lr": 0.1, "momentum": 0.9}}
    jarch, params, buffers, tarch = _setup(layers, scale=0.2)
    initial = {k: v.clone() for k, v in tarch.state_dict().items()}
    rng = np.random.default_rng(5)
    xs = rng.integers(0, 64, (2, 3, 40))
    ys = rng.integers(0, 64, (2, 3, 40))
    opt = jdsl.build_optimizer(sgd)
    fn = jarch.train_epoch_fn(sgd, 2)
    new_params, _, new_buffers, cost, _ = fn(
        dict(params), opt.init(params), buffers,
        jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32),
        jax.random.key(0))
    topt = build_optimizer(sgd, list(tarch.parameters()))
    tcost, _ = tarch.train_epoch(topt, torch.as_tensor(xs),
                                 torch.as_tensor(ys))
    np.testing.assert_allclose(float(tcost), float(cost), rtol=1e-5)
    fractions = [k for k in new_buffers if k.endswith("router_fraction")]
    assert len(fractions) == 2
    for key, value in tarch.state_dict().items():
        want = new_params.get(key, new_buffers.get(key))
        np.testing.assert_allclose(value.numpy(), np.asarray(want),
                                   atol=1e-5, err_msg=key)
    # the second micro-step's routing stands, not the first's
    probe = TArch(layers)
    probe.load_state_dict(initial)
    routed = []
    with torch.no_grad():
        for x in xs:
            probe(torch.as_tensor(x), training=True)
            routed.append({k: probe.state_dict()[k].clone()
                           for k in fractions})
    for key in fractions:
        torch.testing.assert_close(routed[1][key], tarch.state_dict()[key],
                                   atol=1e-6, rtol=0)
    assert any(not torch.equal(routed[0][k], routed[1][k])
               for k in fractions)
    for key in fractions:
        assert abs(float(tarch.state_dict()[key].sum()) - 1.0) < 1e-6


def test_validation_errors_match_jax():
    cases = [dict(top_k=0), dict(top_k=7), dict(bias=True),
             dict(dispatch="sparse"), dict(capacity_factor=0.0)]
    for case in cases:
        args = dict(VARIANTS["dense"]["moe"], **case)
        with pytest.raises(ValueError) as jerr:
            JM.MixtureOfExperts(**args)
        with pytest.raises(ValueError) as terr:
            TM.MixtureOfExperts(**args)
        assert str(terr.value) == str(jerr.value)


@pytest.fixture
def shared_ckpt(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return workdir


def test_checkpoints_round_trip_both_ways(shared_ckpt):
    """The stacked expert weights and the buffer cross in both directions
    through ``PENROZC1`` checkpoints."""
    layers = _moe_lm("capacity", shared_expert_size=8)
    sgd = {"sgd": {"lr": 0.1}}
    jm = JModel("jmoe", JMapper(layers, sgd))
    jm.buffers = {k: v + 0.25 for k, v in jm.buffers.items()}
    jm.serialize(sync_flush=True)
    tm = NeuralNetworkModel.deserialize("jmoe", device="cpu")
    for key, value in {**jm.params, **jm.buffers}.items():
        np.testing.assert_array_equal(tm.state_dict()[key].numpy(),
                                      np.asarray(value), err_msg=key)
    with torch.no_grad():
        for key, buf in tm.arch.named_buffers():
            buf.mul_(3.0)
    tm.model_id = "tmoe"
    tm.serialize(sync_flush=True)
    tckpt.join_flushes()
    back = JModel.deserialize("tmoe")
    assert set(back.params) == set(jm.params)
    assert set(back.buffers) == set(jm.buffers)
    for key, value in tm.state_dict().items():
        got = back.params.get(key, back.buffers.get(key))
        np.testing.assert_array_equal(np.asarray(got), value.numpy(),
                                      err_msg=key)


def test_checkpoint_without_the_buffer_migrates(shared_ckpt):
    """A checkpoint written before the module had ``router_fraction``
    loads in both packages with the buffer at its default (zeros), and the
    port then trains and serializes it."""
    layers = _moe_lm()
    sgd = {"sgd": {"lr": 0.1}}
    jm = JModel("old", JMapper(layers, sgd))
    jm.buffers = {}
    jm.serialize(sync_flush=True)
    back = JModel.deserialize("old")
    tm = NeuralNetworkModel.deserialize("old", device="cpu")
    keys = [k for k in tm.state_dict() if k.endswith("router_fraction")]
    assert keys and set(keys) == set(back.buffers)
    for key in keys:
        assert not tm.state_dict()[key].any()
        np.testing.assert_array_equal(np.asarray(back.buffers[key]),
                                      np.zeros(4, np.float32))
    tm.arch.train_epoch(tm.optimizer, torch.randint(0, 64, (1, 2, 8)),
                        torch.randint(0, 64, (1, 2, 8)))
    assert all(tm.state_dict()[k].sum() > 0 for k in keys)
    tm.serialize(sync_flush=True)


CACHES = {"contiguous": {}, "paged": {"PAGED_KV_CACHE": "1"},
          "int8": {"TURBO_QUANT_KV_CACHE": "1"}}


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
@pytest.mark.parametrize("cache", sorted(CACHES))
def test_greedy_tokens_match_jax(monkeypatch, cache, dispatch):
    """Prompt 5 + 30 new tokens through block 16: the overflow crop and
    re-prefill included; in capacity mode each forward's tokens form the
    groups, the whole prompt at a prefill."""
    for name, value in CACHES[cache].items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    layers = _moe_lm(dispatch, capacity_factor=0.5)
    sgd = {"sgd": {"lr": 0.1}}
    jm = JModel("j", JMapper(layers, sgd))
    tm = from_jax_state_dict(jm.state_dict(), layers, sgd, device="cpu")
    prompt = [3, 17, 42, 8, 11]
    expected = jm.generate_tokens(prompt, 16, 30, temperature=0)
    assert tm.generate_tokens(prompt, 16, 30, temperature=0) == expected
    assert len(expected) == 35


def test_mixed_step_matches_jax_in_capacity_mode(monkeypatch):
    """One packed block of the continuous-batching step (two steps: four
    rows' prefill chunks, then their first decode steps, padding slots
    included) gives the JAX package's samples; the capacity groups are the
    packed (1, Tp) block, and tokens drop in it."""
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.delenv("TURBO_QUANT_KV_CACHE", raising=False)
    layers = _moe_lm("capacity", capacity_factor=0.3)
    sgd = {"sgd": {"lr": 0.1}}
    jm = JModel("j", JMapper(layers, sgd))
    tm = from_jax_state_dict(jm.state_dict(), layers, sgd, device="cpu")
    block, rows, block_q = 16, 4, 8
    prompts = [[3, 17, 42, 8, 11], [7, 5, 9], [1, 2, 3, 4, 5, 6, 7], [9]]
    n, NB = 2, 4
    Tp = NB * block_q
    descs = np.zeros((n, NB, 4), np.int32)
    tok_lit = np.zeros((n, Tp), np.int32)
    tok_src = np.full((n, Tp), -1, np.int32)
    positions = np.zeros((n, Tp), np.int32)
    sample_slot = np.full((n, rows), -1, np.int32)
    for s in range(n):
        spans = ([(i, 0, len(p)) for i, p in enumerate(prompts)] if s == 0
                 else [(i, len(p), 1) for i, p in enumerate(prompts)])
        d, offsets = TKV.build_descriptors(spans, block_q, NB)
        descs[s] = d
        for i, (_, start, q_len) in enumerate(spans):
            slots = TKV.packed_slots(offsets[i], q_len, block_q)
            positions[s, slots] = start + np.arange(q_len)
            if s == 0:
                tok_lit[s, slots] = prompts[i]
            else:
                tok_src[s, slots[0]] = i
            sample_slot[s, i] = slots[-1]
    last = np.zeros(rows, np.int32)
    jkv = (JKV.create_kv_state(jm.arch.kv_specs, rows, block, jnp.float32)
           .with_static_table().with_lengths(np.zeros(rows, np.int32)))
    jout, _ = jm.decode_mixed_step(jkv, descs, tok_lit, tok_src, positions,
                                   sample_slot, last, jax.random.key(0), 0,
                                   temperature=0)
    tkv = (TKV.create_kv_state(tm.arch.kv_specs, rows, block, torch.float32,
                               device="cpu")
           .with_static_table().with_lengths(np.zeros(rows, np.int32)))
    seen = []
    plan = TM.MixtureOfExperts._dispatch_plan

    def spy(gw, cap, dtype):
        disp, combine = plan(gw, cap, dtype)
        seen.append((int((gw > 0).sum()), int(disp.sum())))
        return disp, combine

    monkeypatch.setattr(TM.MixtureOfExperts, "_dispatch_plan",
                        staticmethod(spy))
    tout, _ = tm.decode_mixed_step(tkv, descs, tok_lit, tok_src, positions,
                                   sample_slot, last, temperature=0)
    jout = np.asarray(jout)
    for s in range(n):
        at = sample_slot[s]
        assert tout[s, at].tolist() == jout[s, at].tolist()
    assert len(seen) == 2 * n and all(sel == 2 * Tp for sel, _ in seen)
    assert any(kept < sel for sel, kept in seen)


def test_stats_route_reports_router_fractions_like_jax(shared_ckpt,
                                                       toy_shards):
    """``/stats/`` of an MoE model trained in each package: null before
    training; after it, ``moe_router_fractions`` holds one entry a layer,
    equal to the JAX package's ``router_fraction`` buffers after the same
    training (fp32, <= 1e-5)."""
    layers = _moe_lm()
    sgd = {"sgd": {"lr": 0.1}}
    jm = JModel("moe_stats_jax", JMapper(layers, sgd))
    tm = from_jax_state_dict(jm.state_dict(), layers, sgd,
                             model_id="moe_stats", device="cpu")
    tm.serialize(sync_flush=True)
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % srv.server_address[:2]

    def stats():
        with urllib.request.urlopen(f"{base}/stats/?model_id=moe_stats",
                                    timeout=60) as resp:
            return json.loads(resp.read())

    try:
        assert stats() is None
        run = dict(epochs=2, batch_size=2, block_size=16, step_size=1)
        jm.train_model(toy_shards, **run)
        tm.train_model(toy_shards, **run)
        tckpt.join_flushes()
        doc = stats()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    routing = doc.pop("moe_router_fractions")
    assert doc == tm.stats
    want = {k: np.asarray(v) for k, v in jm.buffers.items()
            if k.endswith("router_fraction")}
    assert set(routing) == set(want) and len(want) == 2
    for key, value in want.items():
        np.testing.assert_allclose(routing[key], value, atol=1e-5,
                                   err_msg=key)
