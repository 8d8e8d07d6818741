"""The port's byte-BPE tokenizer (penroz_tpu_torch/data/bpe.py) against the
JAX package's ``ByteBPE``: on a seeded corpus with multibyte UTF-8, the
port's pure-Python oracle, its native core (native/penroz_bpe.cpp built by
penroz_tpu_torch/utils/native_build.py) and the JAX package's give the
same merges, ids and round trip; model files load across the packages;
``bpe:<path>`` works through the tokenizer facade, ``/tokenize/`` and
``/decode/``, and a dataset download through it writes the JAX package's
shards."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from penroz_tpu.data import bpe as jbpe
from penroz_tpu_torch.data import bpe
from penroz_tpu_torch.data.tokenizers import Tokenizer
from penroz_tpu_torch.utils import native_build

WORDS = ["the", "quick", "brown", "fox", "héllo", "wörld", "naïve", "café",
         "日本語", "テキスト", "emoji😀", "42", "1999", "x", "shells", "ñandú"]


def _corpus(seed: int, n: int = 600) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for w in rng.choice(len(WORDS), n):
        parts.append(WORDS[w])
        parts.append(str(rng.choice([" ", " ", " ", ", ", ". ", "\n", "!"])))
    return "".join(parts)


CORPUS = _corpus(0)
TEXTS = [CORPUS[:300], _corpus(1, 80), "unseen wörds 😀 ok", "", "a",
         "punct!? (mix) 42 日本"]


@pytest.fixture(scope="module")
def trained():
    return bpe.ByteBPE.train_from_text(CORPUS, vocab_size=400)


def test_native_core_loads(trained):
    assert trained.native
    assert native_build.loaded()["penroz_bpe"] is True


def test_merges_equal_the_oracle_and_the_jax_package(trained):
    n = len(trained.merges)
    assert n > 0
    assert bpe._py_train(CORPUS.encode(), n) == trained.merges
    assert jbpe.ByteBPE.train_from_text(CORPUS, 400).merges == trained.merges


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_ids_and_round_trip_equal(trained, i):
    text = TEXTS[i]
    ids = trained.encode(text)
    assert ids == bpe._PyEncoder(trained.merges).encode(text.encode())
    assert ids == jbpe.ByteBPE(trained.merges).encode(text)
    assert trained.decode(ids) == text
    assert all(0 <= t < trained.vocab_size for t in ids)


def test_python_fallback_when_native_missing(monkeypatch, trained):
    monkeypatch.setattr(bpe, "_load_native", lambda: None)
    fallback = bpe.ByteBPE.train_from_text(CORPUS, vocab_size=400)
    assert not fallback.native
    assert fallback.merges == trained.merges
    assert fallback.encode(TEXTS[1]) == trained.encode(TEXTS[1])


def test_model_files_load_across_packages(trained, tmp_path):
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    trained.save(str(ours))
    jbpe.ByteBPE(trained.merges).save(str(theirs))
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    assert jbpe.ByteBPE.load(str(ours)).merges == trained.merges
    assert bpe.ByteBPE.load(str(theirs)).merges == trained.merges
    bad = tmp_path / "bad.json"
    bad.write_text('{"format": "other"}')
    with pytest.raises(ValueError):
        bpe.ByteBPE.load(str(bad))


def test_tokenizer_facade_and_tokenize_route(trained, tmp_path, workdir):
    from penroz_tpu.data.tokenizers import Tokenizer as JTokenizer
    from penroz_tpu_torch.serve.app import create_app
    path = tmp_path / "model.json"
    trained.save(str(path))
    encoding = f"bpe:{path}"
    text = TEXTS[2]
    ours = Tokenizer(encoding)
    tokens = ours.tokenize(text)
    assert tokens == JTokenizer(encoding).tokenize(text)
    assert tokens[-1] == trained.eot_token
    assert ours.decode(tokens) == text
    with pytest.raises(ValueError, match="tiktoken/gpt2"):
        Tokenizer("tiktoken/gpt2")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % srv.server_address[:2]
    try:
        def post(route, body):
            req = urllib.request.Request(
                base + route, data=json.dumps(body).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())

        got = post("/tokenize/", {"encoding": encoding, "text": text})
        assert got["tokens"] == tokens
        back = post("/decode/", {"encoding": encoding, "tokens": tokens})
        assert back["text"] == text
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)
    assert not thread.is_alive()


def test_dataset_shards_through_bpe_equal_jax(trained, tmp_path, workdir,
                                              monkeypatch):
    """``Downloader`` with a ``bpe:<path>`` encoding (the encoding ``POST
    /dataset/`` passes) writes the JAX package's shards byte for byte."""
    import os
    import sys
    import types
    from penroz_tpu.data.loaders import Downloader as JDownloader
    from penroz_tpu_torch.data.loaders import Downloader
    path = tmp_path / "model.json"
    trained.save(str(path))
    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda p, name=None, split="train": {"text": TEXTS}
    monkeypatch.setitem(sys.modules, "datasets", fake)
    JDownloader("j", shard_size=64, encoding=f"bpe:{path}").download("p")
    Downloader("t", shard_size=64, encoding=f"bpe:{path}").download("p")
    jfiles = sorted(f for f in os.listdir("data") if f.startswith("j_"))
    tfiles = sorted(f for f in os.listdir("data") if f.startswith("t_"))
    assert len(jfiles) == len(tfiles) > 2
    for jf, tf in zip(jfiles, tfiles):
        assert (workdir / "data" / jf).read_bytes() == \
            (workdir / "data" / tf).read_bytes(), tf
