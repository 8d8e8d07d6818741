"""Draft-free speculative decoding: prompt-lookup drafts and their
acceptance (counterpart of penroz_tpu/serve/spec_decode.py).

Without speculation every decode step advances a row by one token.
Prompt lookup proposes, when the trailing ``n``-gram of a row's context
(prompt + generated tokens) occurred earlier in that context, the tokens
that followed it; the scheduler's **verify span** feeds the row's last
token and the draft at K+1 positions of one unified block
(serve/decode_scheduler.py), and emits the longest prefix of the draft
that matches the model's own tokens plus the model's token after it.
Positions past the accepted ones are never attended: the host length is
set past the accepted run and the next span overwrites the rest.

Sampling (temperature > 0) stays exact: the engine samples every slot
with a positional key (``CompiledArch._sample_packed``), so the token at
(row, position) is one deterministic draw ``t ~ p`` whichever dispatch
carries the slot.  For a point-mass draft the accept/resample rule
reduces to "accept ``d`` iff ``t == d``, else emit ``t``", which is the
same longest-matching-prefix comparison as greedy's.  Spec-on therefore
emits the stream spec-off emits, at any temperature.

Knobs::

    PENROZ_SPEC_DECODE=1   enable
    PENROZ_SPEC_K          max draft tokens per verify span (default 4)
    PENROZ_SPEC_NGRAM      trailing-match length (default 3)

Pure host policy: which tokens to propose and how many matched.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

ENABLE_ENV = "PENROZ_SPEC_DECODE"
K_ENV = "PENROZ_SPEC_K"
NGRAM_ENV = "PENROZ_SPEC_NGRAM"


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "0") == "1"


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except ValueError:
        log.warning("Unparseable %s=%r; using default %d", name,
                    os.environ.get(name), default)
        return default


def draft_k() -> int:
    """Max draft tokens proposed per verify span (``PENROZ_SPEC_K``)."""
    return _env_int(K_ENV, 4)


def ngram() -> int:
    """Trailing-n-gram match length (``PENROZ_SPEC_NGRAM``)."""
    return _env_int(NGRAM_ENV, 3)


def propose(history, k: int, n: int) -> list[int]:
    """Up to ``k`` draft tokens for the next positions of ``history``
    (prompt + generated so far): the tokens that followed the most recent
    EARLIER occurrence of the trailing ``n``-gram, ``[]`` when there is
    none.  The draft is cut to a power-of-two length, so verify spans are
    2, 3, 5, 9, ... rows long."""
    L = len(history)
    if k < 1 or L <= n:
        return []
    pattern = list(history[-n:])
    for i in range(L - n - 1, -1, -1):
        if list(history[i:i + n]) == pattern:
            cont = history[i + n:i + n + k]
            if not cont:
                return []
            keep = 1 << (len(cont).bit_length() - 1)
            return [int(t) for t in cont[:keep]]
    return []


def accept_length(draft, out) -> int:
    """Number of draft tokens accepted: ``draft[j]`` is accepted iff it
    equals ``out[j]`` (the model's token after consuming positions <= j)
    and every earlier draft token was accepted.  The scheduler then emits
    ``out[:accepted + 1]``: what ``accepted + 1`` plain decode steps would
    have produced."""
    a = 0
    for d, o in zip(draft, out):
        if int(d) != int(o):
            break
        a += 1
    return a
