"""Byte-level BPE tokenizer over the native C++ core (counterpart of
penroz_tpu/data/bpe.py, the same scheme, model files and ids).

The core is ``native/penroz_bpe.cpp``, compiled at first use with g++ as a
CPython extension (utils/native_build.py).  A pure-Python version of the
same algorithm is the fallback where the toolchain is missing (logged
once) and the oracle the core's tests hold it to.  This is host code:
no device runs it.

Scheme ("penroz-bpe"): byte symbols 0..255; words pre-split as
``{optional leading space}letters | digits | single other byte``; training
merges the highest-count adjacent pair (ties: smallest pair) until the target
vocab or no pair repeats; encoding greedily applies the lowest-rank merge.
"""

from __future__ import annotations

import json
import logging
from collections import Counter, defaultdict

log = logging.getLogger(__name__)

FORMAT = "penroz-bpe"


def _load_native():
    from penroz_tpu_torch.utils import native_build
    return native_build.load_extension("penroz_bpe")


# ---------------------------------------------------------------------------
# Pure-Python oracle (mirrors native/penroz_bpe.cpp exactly)
# ---------------------------------------------------------------------------

def _is_letter(c: int) -> bool:
    return 97 <= c <= 122 or 65 <= c <= 90 or c >= 0x80


def _is_digit(c: int) -> bool:
    return 48 <= c <= 57


def split_words(data: bytes) -> list[bytes]:
    """Pre-split bytes into BPE words: [space]letters+ | digits+ | other."""
    words = []
    i, n = 0, len(data)
    while i < n:
        start = i
        j = i
        if data[j] == 0x20 and j + 1 < n and _is_letter(data[j + 1]):
            j += 1
        if j < n and _is_letter(data[j]):
            while j < n and _is_letter(data[j]):
                j += 1
            words.append(data[start:j])
            i = j
        elif j < n and _is_digit(data[j]):
            while j < n and _is_digit(data[j]):
                j += 1
            words.append(data[start:j])
            i = j
        else:
            words.append(data[start:start + 1])
            i = start + 1
    return words


def _py_train(corpus: bytes, num_merges: int) -> list[tuple[int, int]]:
    """Train merges — byte-exact oracle for the native trainer."""
    word_counts = Counter(split_words(corpus))
    words = [[list(w), c] for w, c in word_counts.items()]

    pair_counts: Counter = Counter()
    pair_words: defaultdict = defaultdict(set)
    for wi, (syms, count) in enumerate(words):
        for k in range(len(syms) - 1):
            pair = (syms[k], syms[k + 1])
            pair_counts[pair] += count
            pair_words[pair].add(wi)

    merges: list[tuple[int, int]] = []
    next_id = 256
    for _ in range(num_merges):
        best = None
        best_count = 0
        for pair, count in pair_counts.items():
            if count > best_count or (count == best_count and best is not None
                                      and pair < best):
                best = pair
                best_count = count
        if best_count < 2:
            break
        new_id = next_id
        next_id += 1
        merges.append(best)
        for wi in list(pair_words[best]):
            syms, wc = words[wi]
            for k in range(len(syms) - 1):
                pair = (syms[k], syms[k + 1])
                if pair in pair_counts:
                    pair_counts[pair] -= wc
                    if pair_counts[pair] <= 0:
                        del pair_counts[pair]
                if pair in pair_words:
                    pair_words[pair].discard(wi)
            out = []
            k = 0
            while k < len(syms):
                if (k + 1 < len(syms) and syms[k] == best[0]
                        and syms[k + 1] == best[1]):
                    out.append(new_id)
                    k += 2
                else:
                    out.append(syms[k])
                    k += 1
            words[wi][0] = out
            for k in range(len(out) - 1):
                pair = (out[k], out[k + 1])
                pair_counts[pair] += wc
                pair_words[pair].add(wi)
    return merges


class _PyEncoder:
    """Greedy lowest-rank BPE encoder — oracle for the native Encoder."""

    def __init__(self, merges):
        self.ranks = {tuple(p): i for i, p in enumerate(merges)}
        self.pair_ids = {tuple(p): 256 + i for i, p in enumerate(merges)}
        self.vocab = [bytes([b]) for b in range(256)]
        for a, b in merges:
            self.vocab.append(self.vocab[a] + self.vocab[b])

    def _encode_word(self, word: bytes) -> list[int]:
        syms = list(word)
        while len(syms) >= 2:
            best_rank = None
            best_pos = 0
            for k in range(len(syms) - 1):
                rank = self.ranks.get((syms[k], syms[k + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank = rank
                    best_pos = k
            if best_rank is None:
                break
            pair = (syms[best_pos], syms[best_pos + 1])
            syms[best_pos:best_pos + 2] = [self.pair_ids[pair]]
        return syms

    def encode(self, data: bytes) -> list[int]:
        ids: list[int] = []
        for word in split_words(data):
            ids.extend(self._encode_word(word))
        return ids

    def decode(self, ids) -> bytes:
        return b"".join(self.vocab[i] for i in ids
                        if 0 <= i < len(self.vocab))


# ---------------------------------------------------------------------------
# Public facade
# ---------------------------------------------------------------------------

class ByteBPE:
    """Trained byte-BPE model: merges + (native or Python) encoder."""

    def __init__(self, merges):
        self.merges = [tuple(int(a) for a in m) for m in merges]
        native = _load_native()
        if native is not None:
            self._enc = native.Encoder(self.merges)
            self.native = True
        else:
            self._enc = _PyEncoder(self.merges)
            self.native = False

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    @property
    def eot_token(self) -> int:
        """End-of-text id — one past the merge vocabulary."""
        return self.vocab_size

    @classmethod
    def train_from_text(cls, text: str, vocab_size: int = 512) -> "ByteBPE":
        num_merges = max(0, int(vocab_size) - 256)
        data = text.encode()
        native = _load_native()
        if native is not None:
            merges = [tuple(m) for m in native.train(data, num_merges)]
        else:
            merges = _py_train(data, num_merges)
        return cls(merges)

    def encode(self, text: str) -> list[int]:
        return [int(t) for t in self._enc.encode(text.encode())]

    def decode(self, ids) -> str:
        raw = self._enc.decode([int(t) for t in ids])
        return bytes(raw).decode("utf-8", errors="replace")

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"format": FORMAT,
                       "merges": [list(m) for m in self.merges]}, f)

    @classmethod
    def load(cls, path: str) -> "ByteBPE":
        with open(path) as f:
            data = json.load(f)
        if data.get("format") != FORMAT:
            raise ValueError(f"Not a {FORMAT} model file: {path}")
        return cls(data["merges"])
