"""Legacy batched generation in the port against the JAX package:
``generate_tokens_batched`` (a right-padded prefill, then ragged decode
steps) gives JAX's greedy tokens on the four caches, with and without a
stop token, and equals the port's single-sequence tokens; a hybrid or
pure-SSM model gives JAX's tokens on prompts of equal length and each
row's single-sequence tokens on prompts of unequal length (where the JAX
package's padded prefill feeds the pads to the recurrent state and its
shorter rows leave their own tokens, recorded below).  ``/generate_batch/`` without continuous batching, with
adapter rows (grouped by adapter), and as the breaker's fallback under
``PENROZ_SCHED_FALLBACK=1`` answers what the JAX app answers, on one
shared checkpoint."""

import asyncio
import json
import threading
import urllib.error
import urllib.request

import pytest

from penroz_tpu.models import lora as jlora
from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import adapters as jadapters
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.models import lora, presets
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.serve import adapters
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 120.0
PROMPTS = [[1, 2, 3], [7, 5, 9, 11, 4, 4, 2, 8], [5, 6]]
CACHES = {"fp32": {}, "int8": {"TURBO_QUANT_KV_CACHE": "1"},
          "paged_fp32": {"PAGED_KV_CACHE": "1", "PENROZ_KV_PAGE_SIZE": "4"},
          "paged_int8": {"PAGED_KV_CACHE": "1", "PENROZ_KV_PAGE_SIZE": "4",
                         "TURBO_QUANT_KV_CACHE": "1"}}
_KNOBS = ("PAGED_KV_CACHE", "PENROZ_KV_PAGE_SIZE", "TURBO_QUANT_KV_CACHE",
          "PENROZ_CONTINUOUS_BATCHING", "PENROZ_SCHED_FALLBACK",
          "PENROZ_ENGINE_MAX_CRASHES", "PENROZ_BREAKER_COOLDOWN_MS",
          faults.ENV)


def _layers():
    return jpresets.gpt2_custom(d=32, heads=4, depth=2, vocab=64,
                                block=BLOCK)


@pytest.fixture(scope="module")
def pair():
    jm = JModel("batched", JMapper(_layers(), SGD))
    tm = from_jax_state_dict(jm.state_dict(), _layers(), SGD, device="cpu")
    return jm, tm


@pytest.fixture
def clean_env(monkeypatch):
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("cache", list(CACHES))
def test_batched_matches_jax_on_every_cache(pair, clean_env, cache):
    for name, value in CACHES[cache].items():
        clean_env.setenv(name, value)
    jm, tm = pair
    want = jm.generate_tokens_batched(PROMPTS, BLOCK, 7, temperature=0)
    got = tm.generate_tokens_batched(PROMPTS, BLOCK, 7, temperature=0)
    assert got == want
    assert got == [tm.generate_tokens(p, BLOCK, 7, temperature=0)
                   for p in PROMPTS]
    stop = want[1][len(PROMPTS[1]) + 2]
    assert tm.generate_tokens_batched(PROMPTS, BLOCK, 7, temperature=0,
                                      stop_token=stop) == \
        jm.generate_tokens_batched(PROMPTS, BLOCK, 7, temperature=0,
                                   stop_token=stop)
    assert tm.generate_tokens_batched(PROMPTS, BLOCK, 0) == PROMPTS


def test_batched_sampling_and_refusals(pair, clean_env):
    """Sampled rows are reproducible under the same generator state and
    stay in the vocabulary; an overlong row and an empty prompt are
    ValueErrors; a model with ssm layers is served (see the hybrid
    cases below)."""
    _, tm = pair
    tm._generator.manual_seed(5)
    first = tm.generate_tokens_batched(PROMPTS, BLOCK, 6, temperature=0.8,
                                       top_k=8)
    tm._generator.manual_seed(5)
    assert tm.generate_tokens_batched(PROMPTS, BLOCK, 6, temperature=0.8,
                                      top_k=8) == first
    assert all(0 <= t < 64 for seq in first for t in seq)
    with pytest.raises(ValueError, match="row 1"):
        tm.generate_tokens_batched(PROMPTS, BLOCK, 9)
    with pytest.raises(ValueError, match="at least one token"):
        tm.generate_tokens_batched([[1], []], BLOCK, 2)
    hybrid = presets.hybrid_custom(16, 2, 2, vocab=32, block=BLOCK,
                                   ssm_every=2)
    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    model = NeuralNetworkModel("hy", Mapper(hybrid, SGD), device="cpu")
    assert model.generate_tokens_batched([[1, 2]], BLOCK, 2,
                                         temperature=0) == [
        model.generate_tokens([1, 2], BLOCK, 2, temperature=0)]


def _wide(x):
    """The DSL with every normal init at std 0.3: at the presets' 0.02 the
    toy's recurrent branch barely moves the logits, and a padded prefill
    would go unseen."""
    if isinstance(x, dict):
        return {k: ({"mean": 0.0, "std": 0.3} if k == "normal" else _wide(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_wide(v) for v in x]
    return x


@pytest.fixture(scope="module", params=[2, 1], ids=["hybrid", "pure_ssm"])
def ssm_pair(request):
    layers = _wide(jpresets.hybrid_custom(d=32, heads=4, depth=2, vocab=64,
                                          block=BLOCK, dropout=0.0,
                                          ssm_every=request.param))
    jm = JModel("batched_ssm", JMapper(layers, SGD))
    tm = from_jax_state_dict(jm.state_dict(), layers, SGD, device="cpu")
    return request.param, jm, tm


@pytest.mark.parametrize("cache", list(CACHES))
def test_batched_ssm_rows_match_jax_and_single_sequence(ssm_pair, clean_env,
                                                        cache):
    """Prompts of equal length: the JAX package's batched tokens.  Prompts
    of unequal length: each row's single-sequence tokens (the port's and
    the JAX package's), the pads left out of the recurrent state.  The
    JAX package's own batch leaves them there: its rows [1, 2, 3] and
    [5, 6] first differ from their single-sequence tokens at the second
    new token (index 4), which this test records."""
    for name, value in CACHES[cache].items():
        clean_env.setenv(name, value)
    every, jm, tm = ssm_pair
    equal = [[1, 2, 3], [7, 5, 9], [5, 6, 8]]
    assert tm.generate_tokens_batched(equal, BLOCK, 7, temperature=0) == \
        jm.generate_tokens_batched(equal, BLOCK, 7, temperature=0)
    n = BLOCK - max(map(len, PROMPTS))
    got = tm.generate_tokens_batched(PROMPTS, BLOCK, n, temperature=0)
    single = [jm.generate_tokens([p], BLOCK, n, temperature=0)
              for p in PROMPTS]
    assert got == single
    assert got == [tm.generate_tokens(p, BLOCK, n, temperature=0)
                   for p in PROMPTS]
    if cache == "fp32":
        jax_batched = jm.generate_tokens_batched(PROMPTS, BLOCK, n,
                                                 temperature=0)
        assert jax_batched[1] == single[1]   # the longest row: no pads
        for row in (0, 2):
            first = next(i for i, (a, b) in enumerate(
                zip(jax_batched[row], single[row])) if a != b)
            assert first <= len(PROMPTS[row]) + 2, (row, first)


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            raw, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    body = json.loads(raw) if raw else None
    if isinstance(body, dict):
        body.pop("request_id", None)
    return status, body


def _serve_jax():
    from aiohttp import web

    from penroz_tpu.serve import app as app_mod
    app_mod.model_locks.clear()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app_mod.create_app())
    started = threading.Event()
    box = {}

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"] = site._server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(WAIT_S)

    def close():
        asyncio.run_coroutine_threadsafe(runner.cleanup(),
                                         loop).result(WAIT_S)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(WAIT_S)
        loop.close()

    return f"http://127.0.0.1:{box['port']}", close


def _serve_torch():
    from penroz_tpu_torch.serve.app import create_app
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]

    def close():
        srv.shutdown()
        srv.server_close()
        thread.join(WAIT_S)

    return f"http://{host}:{port}", close


def _batch(**kw):
    body = {"model_id": "batched", "inputs": PROMPTS, "block_size": BLOCK,
            "max_new_tokens": 6, "temperature": 0}
    body.update(kw)
    return body


def test_generate_batch_routes_match_jax_app(pair, workdir, clean_env):
    """Both apps on one checkpoint and one adapter: the legacy batch, with
    a stop token, with adapter rows, and the breaker's fallback (one crash
    opens it; the batch is answered by the legacy path)."""
    jm, _ = pair
    clean_env.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    jm.serialize(sync_flush=True)
    cfg = jlora.validate_config({"rank": 4})
    params = jlora.init_params(jm.arch, cfg, seed=7, init="random")
    lora.save_adapter("a1", "batched", cfg, params, {"code": "Created"},
                      sync_flush=True)
    want_plain = jm.generate_tokens_batched(PROMPTS, BLOCK, 6, temperature=0)
    bound = jlora.bind_model(jm, params, cfg)
    want_adapter = [bound.generate_tokens([PROMPTS[0]], BLOCK, 6,
                                          temperature=0),
                    want_plain[1],
                    bound.generate_tokens([PROMPTS[2]], BLOCK, 6,
                                          temperature=0)]

    def script(base):
        clean_env.delenv("PENROZ_CONTINUOUS_BATCHING", raising=False)
        out = [_call(base, "POST", "/generate_batch/", _batch()),
               _call(base, "POST", "/generate_batch/",
                     _batch(stop_token=want_plain[0][4])),
               _call(base, "POST", "/generate_batch/",
                     _batch(adapter_ids=["a1", None, "a1"])),
               _call(base, "POST", "/generate_batch/",
                     _batch(inputs=[[1] * 12]))[0]]
        clean_env.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
        clean_env.setenv("PENROZ_ENGINE_MAX_CRASHES", "1")
        clean_env.setenv("PENROZ_BREAKER_COOLDOWN_MS", "60000")
        clean_env.setenv(faults.ENV, "decode.step:raise@1+")
        for mod in (faults, jfaults):
            mod.reset()
        out.append(_call(base, "POST", "/generate_batch/",
                         _batch(inputs=[PROMPTS[0]]))[0])
        out.append(_call(base, "POST", "/generate_batch/", _batch())[0])
        clean_env.setenv("PENROZ_SCHED_FALLBACK", "1")
        out.append(_call(base, "POST", "/generate_batch/", _batch()))
        for name in ("PENROZ_SCHED_FALLBACK", "PENROZ_ENGINE_MAX_CRASHES",
                     "PENROZ_BREAKER_COOLDOWN_MS", faults.ENV,
                     "PENROZ_CONTINUOUS_BATCHING"):
            clean_env.delenv(name)
        return out

    got = {}
    for side, serve in (("jax", _serve_jax), ("torch", _serve_torch)):
        for mod in (adapters, jadapters):
            mod.REGISTRY.reset()
        base, close = serve()
        try:
            got[side] = script(base)
        finally:
            close()
            DS.reset()
            JDS.reset()
            for mod in (faults, jfaults):
                mod.reset()
            for mod in (adapters, jadapters):
                mod.REGISTRY.reset()
    assert got["torch"] == got["jax"]
    plain, stopped, mixed, overlong, crashed, shed, fallback = got["torch"]
    assert plain == (200, {"sequences": want_plain})
    assert stopped[0] == 200 and stopped[1]["sequences"][0] == \
        want_plain[0][:5]
    assert mixed == (200, {"sequences": want_adapter})
    assert (overlong, crashed, shed) == (400, 500, 503)
    assert fallback == (200, {"sequences": want_plain})
