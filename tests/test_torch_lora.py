"""The port's LoRA adapters (models/lora.py, ops/modules.Linear, the decode
runners' adapter buffers, utils/checkpoint.py's adapter family,
serve/adapters.py) against the JAX package's, on the same base weights
and adapter factors.

Tolerances: deltas fp32, max abs diff <= 1e-5 (``ATOL``); logits
through the whole stack ``ATOL`` absolute plus ``ATOL`` relative (a random
adapter's logits reach ~9, where the JAX package's own bound and merged
forwards differ by 5.5e-6); adapter-training costs per epoch and factors
<= 1e-4 (``COST_ATOL``).  Prefix lists,
factors drawn from a seed and greedy tokens are compared exactly.  The
JAX oracles are computed once per module."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models import lora as jlora
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.ops import modules as JM
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models import decode_graphs, lora
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.ops import modules as TM
from penroz_tpu_torch.serve import adapters
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

ATOL = 1e-5
COST_ATOL = 1e-4
BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
PROMPT = [1, 2, 3]


def _gpt(d=32, heads=4, vocab=64):
    """The conftest ``toy_gpt_layers`` stack (d 32, 4 heads, vocab 64,
    block 16, an untied head)."""
    return ([{"summation": [
                {"embedding": {"num_embeddings": vocab, "embedding_dim": d}},
                {"position": {"num_embeddings": BLOCK, "embedding_dim": d}}]}]
            + [{"residual": [
                {"sequential": [
                    {"layernorm": {"normalized_shape": d}},
                    {"linear": {"in_features": d, "out_features": 3 * d}},
                    {"attention": {"num_heads": heads, "dropout": 0.0}},
                    {"linear": {"in_features": d, "out_features": d}}]},
                {"sequential": [
                    {"layernorm": {"normalized_shape": d}},
                    {"linear": {"in_features": d, "out_features": 4 * d}},
                    {"gelu": {}},
                    {"linear": {"in_features": 4 * d, "out_features": d}}]}]}
               for _ in range(2)]
            + [{"layernorm": {"normalized_shape": d}},
               {"linear": {"in_features": d, "out_features": vocab,
                           "bias": False}},
               {"softmaxlast": {"dim": -1}}])


def _gated():
    """RMSNorm, RoPE and a gated (SwiGLU) MLP in transformer blocks."""
    def block():
        return {"transformerblock": {
            "attn_block": {"sequential": [
                {"rmsnorm": {"normalized_shape": 16}},
                {"linear": {"in_features": 16, "out_features": 32,
                            "bias": False}},
                {"attention": {"num_heads": 4, "num_kv_heads": 2,
                               "rope_theta": 10000.0, "head_dim": 4}},
                {"linear": {"in_features": 16, "out_features": 16,
                            "bias": False}}]},
            "mlp_block": {"sequential": [
                {"rmsnorm": {"normalized_shape": 16}},
                {"gatedmlp": {"in_features": 16, "intermediate_size": 24,
                              "activation": "silu"}}]}}}
    return ([{"embedding": {"num_embeddings": 32, "embedding_dim": 16}},
             block(), block(), {"rmsnorm": {"normalized_shape": 16}},
             {"linear": {"in_features": 16, "out_features": 32,
                         "bias": False}},
             {"softmaxlast": {"dim": -1}}])


def _moe():
    """An attention block whose MLP is a mixture of experts (its router
    and expert stacks are no Linear)."""
    return ([{"embedding": {"num_embeddings": 32, "embedding_dim": 16}},
             {"residual": [
                 {"sequential": [
                     {"layernorm": {"normalized_shape": 16}},
                     {"linear": {"in_features": 16, "out_features": 48}},
                     {"attention": {"num_heads": 4}},
                     {"linear": {"in_features": 16, "out_features": 16}}]},
                 {"sequential": [
                     {"layernorm": {"normalized_shape": 16}},
                     {"moe": {"in_features": 16, "intermediate_size": 24,
                              "num_experts": 4, "top_k": 2}}]}]},
             {"linear": {"in_features": 16, "out_features": 32}},
             {"softmaxlast": {"dim": -1}}])


TOYS = {"gpt": _gpt, "gated": _gated, "moe": _moe}


def _pair(layers, model_id="loragpt"):
    jm = JModel(model_id, JMapper(layers, SGD))
    tm = from_jax_state_dict(jm.state_dict(), layers, SGD,
                             model_id=model_id, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def gpt_pair():
    return _pair(_gpt())


@pytest.fixture(scope="module")
def oracle(gpt_pair):
    """The JAX package's numbers for one random rank-4 adapter of the toy
    GPT, computed once: its factors, the bound forward's logits, the
    merged-weight forward's, and greedy tokens (base, bound, zero-B)."""
    jm, _ = gpt_pair
    cfg = jlora.validate_config({"rank": 4})
    params = jlora.init_params(jm.arch, cfg, seed=1, init="random")
    zero = jlora.init_params(jm.arch, cfg, seed=1)
    x = np.random.default_rng(0).integers(0, 64, (2, BLOCK))
    bound = jlora.bind_model(jm, params, cfg)
    acts, _, _, _ = jm.arch.forward(bound.params, jm.buffers,
                                    jnp.asarray(x), skip_softmax=True)
    merged = jlora.merge_weights(jm.params, params, cfg)
    macts, _, _, _ = jm.arch.forward(merged, jm.buffers, jnp.asarray(x),
                                     skip_softmax=True)
    return {
        "cfg": cfg, "params": params, "x": x,
        "logits": np.asarray(acts[-1]), "merged": np.asarray(macts[-1]),
        "base_tokens": jm.generate_tokens([PROMPT], BLOCK, 8,
                                          temperature=0.0),
        "bound_tokens": bound.generate_tokens([PROMPT], BLOCK, 8,
                                              temperature=0.0),
        "zero_tokens": jlora.bind_model(jm, zero, cfg).generate_tokens(
            [PROMPT], BLOCK, 8, temperature=0.0),
    }


@pytest.fixture
def shared_dirs(workdir, monkeypatch):
    """Both packages read and write the same models/ and shm dirs."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    from penroz_tpu.serve import adapters as jadapters
    adapters.REGISTRY.reset()
    jadapters.REGISTRY.reset()
    faults.reset()
    yield workdir
    adapters.REGISTRY.reset()
    jadapters.REGISTRY.reset()
    faults.reset()
    tckpt.join_flushes()


# ---------------------------------------------------------------------------
# Prefixes, factors, configs, packs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("toy", sorted(TOYS))
def test_target_linears_match_jax(toy):
    jm, tm = _pair(TOYS[toy]())
    assert lora.target_linears(tm.arch) == jlora.target_linears(jm.arch)
    for targets in (["layers.1"], ["0.1", "gate_proj"]):
        try:
            want = jlora.target_linears(jm.arch, targets)
        except ValueError:
            with pytest.raises(ValueError, match="match no Linear"):
                lora.target_linears(tm.arch, targets)
            continue
        assert lora.target_linears(tm.arch, targets) == want
    with pytest.raises(ValueError, match="match no Linear"):
        lora.target_linears(tm.arch, ["nomatch"])


@pytest.mark.parametrize("init", ["zeros", "random"])
@pytest.mark.parametrize("targets", [None, ["layers.1"]], ids=["all", "one"])
def test_init_params_bit_equal_to_jax(gpt_pair, init, targets):
    jm, tm = gpt_pair
    cfg = jlora.validate_config({"rank": 3, "targets": targets})
    want = jlora.init_params(jm.arch, cfg, seed=7, init=init)
    got = lora.init_params(tm.arch, lora.validate_config(
        {"rank": 3, "targets": targets}), seed=7, init=init)
    assert list(got) == list(want)
    for key, v in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], v)


@pytest.mark.parametrize("config,max_rank", [
    ({"rank": 4}, None), ({"rank": 16, "alpha": 3}, None),
    ({"rank": 2, "targets": ["layers.1"]}, None), ({}, None),
    ({"rank": 8}, "8"), ({"rank": 9}, "8"), ({"rank": 0}, None),
    ({"rank": 17}, None), ({"rank": 4, "targets": []}, None)])
def test_validate_config_matches_jax(monkeypatch, config, max_rank):
    if max_rank is not None:
        monkeypatch.setenv(lora.MAX_RANK_ENV, max_rank)
    try:
        want = jlora.validate_config(config)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            lora.validate_config(config)
        assert str(got.value) == str(e)
        return
    assert lora.validate_config(config) == want
    assert lora.scale(want) == jlora.scale(want)


def test_build_pack_matches_jax(gpt_pair, monkeypatch):
    monkeypatch.setenv(lora.MAX_RANK_ENV, "8")
    jm, _ = gpt_pair
    slots = []
    for rank, seed, targets in ((4, 1, None), (2, 2, ["layers.1"])):
        cfg = jlora.validate_config({"rank": rank, "targets": targets})
        slots.append((jlora.init_params(jm.arch, cfg, seed=seed,
                                        init="random"), cfg))
    params = [p for p, _ in slots] + [None]
    cfgs = [c for _, c in slots] + [None]
    want = jlora.build_pack(params, cfgs, 3)
    got = lora.build_pack(params, cfgs, 3)
    assert list(got) == list(want)
    for prefix, ent in want.items():
        for k in ("a", "b", "scale"):
            assert tuple(got[prefix][k].shape) == ent[k].shape
            np.testing.assert_array_equal(got[prefix][k].numpy(),
                                          np.asarray(ent[k]))
        assert not got[prefix]["a"][3].any()   # the base slot
    assert lora.build_pack([None, None], [None, None], 2) is None


# ---------------------------------------------------------------------------
# The delta: bound, per row, per token
# ---------------------------------------------------------------------------

def test_bound_logits_match_jax_and_merge_oracle(gpt_pair, oracle):
    _, tm = gpt_pair
    binding = lora.bind(oracle["params"], oracle["cfg"], "cpu")
    with torch.no_grad():
        acts, _, _ = tm.arch(torch.as_tensor(oracle["x"]), skip_softmax=True,
                             adapter=binding)
    got = acts[-1].numpy()
    np.testing.assert_allclose(got, oracle["logits"], atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got, oracle["merged"], atol=ATOL, rtol=ATOL)
    merged = lora.merge_weights(dict(tm.arch.named_parameters()),
                                oracle["params"], oracle["cfg"])
    with torch.no_grad():
        macts, _, _ = torch.func.functional_call(
            tm.arch, merged, (torch.as_tensor(oracle["x"]),),
            {"skip_softmax": True})
    np.testing.assert_allclose(macts[-1].numpy(), oracle["merged"],
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_bound_generation_matches_jax(gpt_pair, oracle, monkeypatch, paged):
    """The single-sequence path of a bound copy: the JAX bound model's
    greedy tokens, a zero-B adapter the base model's exactly; the shared
    arch keeps no trace of the adapter (a base request after it serves
    the base tokens on the same runner key's layout)."""
    if paged:
        monkeypatch.setenv("PAGED_KV_CACHE", "1")
        monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    decode_graphs.reset()
    _, tm = gpt_pair
    cfg, params = oracle["cfg"], oracle["params"]
    bound = lora.bind_model(tm, params, cfg)
    assert bound.generate_tokens([PROMPT], BLOCK, 8, temperature=0.0) \
        == oracle["bound_tokens"]
    assert tm.generate_tokens([PROMPT], BLOCK, 8, temperature=0.0) \
        == oracle["base_tokens"]
    zero = lora.init_params(tm.arch, cfg, seed=1)
    assert lora.bind_model(tm, zero, cfg).generate_tokens(
        [PROMPT], BLOCK, 8, temperature=0.0) == oracle["zero_tokens"] \
        == oracle["base_tokens"]
    assert tm.adapter is None


def test_runner_key_carries_the_adapter_shape(gpt_pair, oracle,
                                              monkeypatch):
    """Runners captured without factors never serve an adapter and vice
    versa; adapters that target the same projections share a runner
    (ranks pad to PENROZ_LORA_MAX_RANK), whose buffers each request
    refills (zero past its rank)."""
    _, tm = gpt_pair
    cfg = oracle["cfg"]
    args = (tm.arch, BLOCK, True, None, "cpu")
    base = decode_graphs.runner_key(*args)
    with_a = decode_graphs.runner_key(*args, (oracle["params"], cfg))
    cfg2 = lora.validate_config({"rank": 2})
    other = lora.init_params(tm.arch, cfg2, seed=5, init="random")
    assert base != with_a
    assert decode_graphs.runner_key(*args, (other, cfg2)) == with_a
    some = lora.validate_config({"rank": 2, "targets": ["layers.1"]})
    assert decode_graphs.runner_key(
        *args, (lora.init_params(tm.arch, some), some)) != with_a
    decode_graphs.reset()
    want2 = lora.bind_model(tm, other, cfg2).generate_tokens(
        [PROMPT], BLOCK, 6, temperature=0.0)
    assert lora.bind_model(tm, oracle["params"], cfg).generate_tokens(
        [PROMPT], BLOCK, 8, temperature=0.0) == oracle["bound_tokens"]
    # the idle runner of the key refills for the rank-2 adapter
    assert lora.bind_model(tm, other, cfg2).generate_tokens(
        [PROMPT], BLOCK, 6, temperature=0.0) == want2
    assert decode_graphs.STATS["prefills"] == 3


def _stacked(rank_seed, tm, jm, monkeypatch):
    monkeypatch.setenv(lora.MAX_RANK_ENV, "8")
    slots = []
    for rank, seed in rank_seed:
        cfg = jlora.validate_config({"rank": rank})
        slots.append((jlora.init_params(jm.arch, cfg, seed=seed,
                                        init="random"), cfg))
    params = [p for p, _ in slots]
    cfgs = [c for _, c in slots]
    return (jlora.build_pack(params, cfgs, len(slots)),
            lora.build_pack(params, cfgs, len(slots)))


@pytest.mark.parametrize("form", ["per_row", "per_token", "per_row_2d"])
def test_stacked_delta_matches_jax(gpt_pair, monkeypatch, form):
    """``Linear``'s stacked delta (masked products over every slot)
    against the JAX package's gathered einsum, for the head (32 -> 64)
    and an MLP projection: per row (B,), per packed token (B, T), and per
    row over a 2-D (B, d) input."""
    jm, tm = gpt_pair
    jpack, tpack = _stacked(((4, 1), (2, 2), (8, 3)), tm, jm, monkeypatch)
    rng = np.random.default_rng(4)
    for prefix, (din, dout) in (("layers.4", (32, 64)),
                                ("layers.1.1.1", (32, 128))):
        shape = {"per_row": (3, 5, din), "per_token": (2, 7, din),
                 "per_row_2d": (4, din)}[form]
        x = rng.standard_normal(shape).astype(np.float32)
        idx = (rng.integers(0, 4, shape[:2]) if form == "per_token"
               else rng.integers(0, 4, shape[0]))
        jlin = JM.Linear(din, dout, bias=False).bind(prefix)
        w = rng.standard_normal((dout, din)).astype(np.float32)
        jctx = JM.Ctx({f"{prefix}.weight": jnp.asarray(w)}, lora=jpack,
                      lora_idx=jnp.asarray(idx, jnp.int32))
        want = np.asarray(jlin.apply(jnp.asarray(x), jctx))
        tlin = TM.Linear(din, dout, bias=False)
        tlin.prefix = prefix
        with torch.no_grad():
            tlin.weight.copy_(torch.from_numpy(w))
            got = tlin(torch.from_numpy(x), TM.Ctx(
                lora=tpack, lora_idx=torch.from_numpy(idx))).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        base = x @ w.T
        assert np.abs(got - base).max() > 1e-2   # the delta is there


# ---------------------------------------------------------------------------
# Adapter checkpoints across the packages
# ---------------------------------------------------------------------------

def test_adapter_checkpoint_loads_across_packages(shared_dirs, gpt_pair,
                                                  oracle):
    _, tm = gpt_pair
    cfg, params = oracle["cfg"], oracle["params"]
    jlora.save_adapter("byjax", "loragpt", cfg, params,
                       {"code": "Created", "message": "x"}, sync_flush=True)
    lora.save_adapter("byport", "loragpt", cfg, params,
                      {"code": "Created", "message": "x"}, sync_flush=True)
    assert tckpt.list_adapter_ids() == jckpt.list_adapter_ids() == [
        "byjax", "byport"]
    for aid in ("byjax", "byport"):
        tblob, jblob = tckpt.load_adapter(aid), jckpt.load_adapter(aid)
        assert tblob["config"] == jblob["config"] == cfg
        assert tblob["model_id"] == jblob["model_id"] == "loragpt"
        assert list(tblob["params"]) == list(jblob["params"]) == list(params)
        for k, v in params.items():
            np.testing.assert_array_equal(tblob["params"][k].numpy(), v)
            np.testing.assert_array_equal(np.asarray(jblob["params"][k]), v)
        tpeek, jpeek = (tckpt.peek_adapter_tree(aid),
                        jckpt.peek_adapter_tree(aid))
        assert tpeek["status"] == jpeek["status"] == {"code": "Created",
                                                      "message": "x"}
        assert all(v is None for v in tpeek["params"].values())
    # each package serves the other's adapter with the JAX bound tokens
    entry = adapters.REGISTRY.acquire("byjax", "loragpt")
    assert lora.bind_model(tm, entry.params, entry.config).generate_tokens(
        [PROMPT], BLOCK, 8, temperature=0.0) == oracle["bound_tokens"]
    tckpt.delete_adapter("byport")
    jckpt.delete_adapter("byjax")
    assert tckpt.list_adapter_ids() == []
    for fn in (tckpt.load_adapter, tckpt.peek_adapter_tree):
        with pytest.raises(KeyError):
            fn("byport")


# ---------------------------------------------------------------------------
# The serving registry (JAX tests/test_lora.py's registry cases)
# ---------------------------------------------------------------------------

def _saved(gpt_pair, aid, rank=4, seed=1):
    _, tm = gpt_pair
    cfg = lora.validate_config({"rank": rank, "alpha": 2.0 * rank})
    lora.save_adapter(aid, "loragpt", cfg,
                      lora.init_params(tm.arch, cfg, seed=seed,
                                       init="random"),
                      {"code": "Created"}, sync_flush=True)


def test_registry_acquire_release_and_lru(shared_dirs, gpt_pair,
                                          monkeypatch):
    monkeypatch.setenv(adapters.HOST_CACHE_ENV, "2")
    for i in range(3):
        _saved(gpt_pair, f"a{i}", seed=i)
    e0 = adapters.REGISTRY.acquire("a0", "loragpt")
    assert e0.state == "ready" and e0.refs == 1
    e1 = adapters.REGISTRY.acquire("a1", "loragpt")
    adapters.REGISTRY.release(e1)
    adapters.REGISTRY.acquire("a2", "loragpt")
    assert set(adapters.REGISTRY.cached_ids()) == {"a0", "a2"}
    assert adapters.REGISTRY.acquire("a0", "loragpt").uid == e0.uid
    assert adapters.REGISTRY.entry_state("a0") == {"state": "ready",
                                                   "refs": 2, "uid": e0.uid}
    # rank 4 over the 9 projections: 4 x (in + out) fp32 values each
    _, tm = gpt_pair
    per = sum(4 * (i + o) for _, i, o in lora.target_linears(tm.arch))
    assert adapters.REGISTRY.cache_bytes() == 2 * per * 4


def test_registry_unknown_adapter_is_descriptive_value_error(shared_dirs):
    with pytest.raises(ValueError, match="unknown adapter 'ghost'"):
        adapters.REGISTRY.acquire("ghost", "loragpt")


def test_registry_rejects_over_rank_checkpoint(shared_dirs, gpt_pair,
                                               monkeypatch):
    _saved(gpt_pair, "bigr")
    monkeypatch.setenv(lora.MAX_RANK_ENV, "2")
    with pytest.raises(ValueError, match="rank 4 exceeds"):
        adapters.REGISTRY.acquire("bigr", "loragpt")


def test_registry_model_mismatch(shared_dirs, gpt_pair):
    _saved(gpt_pair, "mm")
    with pytest.raises(ValueError, match="belongs to model 'loragpt'"):
        adapters.REGISTRY.acquire("mm", "othermodel")


def test_registry_load_failure_fault_site(shared_dirs, gpt_pair,
                                          monkeypatch):
    _saved(gpt_pair, "flaky")
    monkeypatch.setenv(faults.ENV, "lora.load:raise@1")
    with pytest.raises(ValueError, match="'flaky' failed to load"):
        adapters.REGISTRY.acquire("flaky", "loragpt")
    assert adapters.REGISTRY.acquire("flaky", "loragpt").state == "ready"


def test_registry_concurrent_load_second_caller_409_shape(shared_dirs,
                                                          gpt_pair,
                                                          monkeypatch):
    _saved(gpt_pair, "slow")
    monkeypatch.setenv(faults.ENV, "lora.load:sleep@300")
    results = {}
    t = threading.Thread(target=lambda: results.update(
        first=adapters.REGISTRY.acquire("slow", "loragpt")))
    t.start()
    time.sleep(0.1)
    with pytest.raises(adapters.AdapterLoadingError, match="still loading"):
        adapters.REGISTRY.acquire("slow", "loragpt")
    t.join(timeout=10)
    assert results["first"].state == "ready"


def test_registry_invalidate_model_drops_entries(shared_dirs, gpt_pair):
    _saved(gpt_pair, "inv")
    old = adapters.REGISTRY.acquire("inv", "loragpt")
    adapters.REGISTRY.invalidate_model("loragpt")
    assert adapters.REGISTRY.cached_ids() == []
    assert adapters.REGISTRY.acquire("inv", "loragpt").uid != old.uid


# ---------------------------------------------------------------------------
# Adapter training: the base frozen, costs as the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", [
    dict(epochs=3, batch_size=2, block_size=8, step_size=1),
    dict(epochs=2, batch_size=4, block_size=8, step_size=2)],
    ids=["one_step", "two_steps"])
def test_train_adapter_matches_jax(shared_dirs, toy_shards, run):
    layers = _gpt()
    jm, tm = _pair(layers)
    jm.serialize(sync_flush=True)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    cfg = {"rank": 2, "targets": ["layers.1", "layers.4"]}
    want = jlora.train_adapter(jm, "jft", jlora.validate_config(cfg),
                               toy_shards, **run)
    got = lora.train_adapter(tm, "tft", lora.validate_config(cfg),
                             toy_shards, **run)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k     # bit-unchanged
    jblob, tblob = jckpt.load_adapter("jft"), tckpt.load_adapter("tft")
    assert tblob["status"]["code"] == "Trained"
    assert [p["epoch"] for p in tblob["progress"]] == list(
        range(1, run["epochs"] + 1))
    np.testing.assert_allclose([p["cost"] for p in tblob["progress"]],
                               [p["cost"] for p in jblob["progress"]],
                               atol=COST_ATOL, rtol=0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=COST_ATOL, rtol=0)
    assert any(got[k].abs().max() > 0 for k in got if k.endswith("lora_B"))
    # the checkpoint serves, and continued training resumes from it
    entry = adapters.REGISTRY.acquire("tft", "loragpt")
    assert len(lora.bind_model(tm, entry.params, entry.config)
               .generate_tokens([PROMPT], BLOCK, 4, temperature=0.0)) == 7


def test_train_adapter_config_mismatch_and_error_status(shared_dirs,
                                                        toy_shards):
    _, tm = _pair(_gpt())
    lora.train_adapter(tm, "shape", lora.validate_config({"rank": 2}),
                       toy_shards, epochs=1, batch_size=1, block_size=8)
    with pytest.raises(ValueError, match="exists with rank=2"):
        lora.train_adapter(tm, "shape", lora.validate_config({"rank": 4}),
                           toy_shards, epochs=1, batch_size=1,
                           block_size=8)
    with pytest.raises(ValueError):
        lora.train_adapter(tm, "bad", lora.validate_config({"rank": 2}),
                           "no-such-dataset", epochs=1, batch_size=1,
                           block_size=8)
    assert tckpt.peek_adapter_tree("bad")["status"]["code"] == "Error"
    with pytest.raises(ValueError, match="belongs to model"):
        _, other = _pair(_gpt(), model_id="other")
        lora.train_adapter(other, "shape",
                           lora.validate_config({"rank": 2}), toy_shards,
                           epochs=1, batch_size=1, block_size=8)
