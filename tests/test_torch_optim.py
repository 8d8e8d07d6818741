"""The port's optimizer DSL (``torch.optim``) against the JAX package's
optax transforms: from the same parameters and gradients, a few steps give
the same parameters, and the state maps to the optax leaves both ways
(``opt_state_leaves`` equals ``jax.tree.leaves`` of the optax state, and a
port optimizer loaded with JAX leaves continues like optax).

Tolerance: rtol 1e-5, atol 1e-7 on fp32 parameters and moments (the same
update formulas, rounded in a different order)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from penroz_tpu.models import dsl as jdsl
from penroz_tpu_torch.models import convert
from penroz_tpu_torch.models import dsl as tdsl

CONFIGS = {
    "adamw": {"adamw": {"lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-8,
                        "weight_decay": 0.1}},
    "adam_wd": {"adam": {"lr": 1e-2, "weight_decay": 0.05}},
    "sgd_momentum": {"sgd": {"lr": 0.1, "momentum": 0.9}},
    "sgd_nesterov": {"sgd": {"lr": 0.1, "momentum": 0.8, "nesterov": True,
                             "weight_decay": 0.01}},
    "sgd": {"sgd": {"lr": 0.1}},
}
SHAPES = {"layers.1.weight": (4, 3), "layers.0.bias": (5,),
          "layers.10.weight": (2, 2)}
TOL = dict(rtol=1e-5, atol=1e-7)


def _setup(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _jax_run(config, params, grads, state=None):
    opt = jdsl.build_optimizer(config)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p) if state is None else state
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, p)
        p = optax.apply_updates(p, updates)
    return p, state


def _port(config, params):
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    return tp, tdsl.build_optimizer(config, list(tp.values()))


def _port_run(tp, opt, grads):
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steps_and_leaves_match_optax(name):
    config = CONFIGS[name]
    params, grads = _setup()
    jp, jstate = _jax_run(config, params, grads)
    tp, opt = _port(config, params)
    _port_run(tp, opt, grads)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   err_msg=k, **TOL)
    jleaves = jax.tree.leaves(jstate)
    leaves = convert.opt_state_leaves(config, opt, tp)
    assert sorted(leaves) == list(range(len(jleaves)))
    for i, want in enumerate(jleaves):
        got = leaves[i].numpy()
        assert got.shape == np.shape(want)
        assert got.dtype == np.asarray(want).dtype, i
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_continues_from_jax_leaves_and_back(name):
    config = CONFIGS[name]
    params, grads = _setup(seed=1, steps=4)
    jp, jstate = _jax_run(config, params, grads[:2])
    # the port resumes from the JAX state after two steps ...
    tp, opt = _port(config, {k: np.asarray(v) for k, v in jp.items()})
    convert.load_opt_state_leaves(
        config, opt, tp, {i: np.asarray(a)
                          for i, a in enumerate(jax.tree.leaves(jstate))})
    _port_run(tp, opt, grads[2:])
    jp2, jstate2 = _jax_run(config, jp, grads[2:], state=jstate)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp2[k]),
                                   err_msg=k, **TOL)
    # ... and optax resumes from the port's leaves
    leaves = convert.opt_state_leaves(config, opt, tp)
    template = jax.tree.structure(jstate2)
    restored = jax.tree.unflatten(template, [jnp.asarray(leaves[i].numpy())
                                             for i in range(len(leaves))])
    jp3, _ = _jax_run(config, {k: p.detach().numpy() for k, p in tp.items()},
                      grads[:1], state=restored)
    _port_run(tp, opt, grads[:1])
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp3[k]),
                                   err_msg=k, **TOL)


def test_fresh_leaves_equal_optax_init_and_bad_counts_raise():
    config = CONFIGS["adamw"]
    params, _ = _setup()
    tp, opt = _port(config, params)
    fresh = convert.opt_state_leaves(config, None, tp)
    init = jax.tree.leaves(jdsl.build_optimizer(config).init(
        {k: jnp.asarray(v) for k, v in params.items()}))
    assert len(fresh) == len(init) == 1 + 2 * len(SHAPES)
    for i, want in enumerate(init):
        np.testing.assert_array_equal(fresh[i].numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="leaves"):
        convert.load_opt_state_leaves(config, opt, tp, {0: np.zeros(())})
