"""Tokenizer facade (counterpart of penroz_tpu/data/tokenizers.py), over the
two offline backends:

- ``byte`` — raw UTF-8 bytes + an EOT id, dependency-free;
- ``bpe:<path>`` — a byte-BPE model file (data/bpe.py) + its EOT id.

The other backends (``tiktoken/…``, HuggingFace names) need downloads or
modules the port does not carry, so they raise ValueError (→ HTTP 400).
"""

from __future__ import annotations

BYTE_EOT = 256


class Tokenizer:
    def __init__(self, encoding: str):
        self.encoding = encoding
        self._bpe = None
        if encoding.startswith("bpe:"):
            from penroz_tpu_torch.data.bpe import ByteBPE
            self._bpe = ByteBPE.load(encoding.split(":", 1)[1])
        elif encoding != "byte":
            raise ValueError(f"encoding {encoding!r} is not available in "
                             f"penroz_tpu_torch; use 'byte' or "
                             f"'bpe:<model file>'")

    def tokenize(self, text: str) -> list[int]:
        if self._bpe is not None:
            return self._bpe.encode(text) + [self._bpe.eot_token]
        return list(text.encode()) + [BYTE_EOT]

    def decode(self, tokens) -> str:
        if self._bpe is not None:
            return self._bpe.decode(tokens)
        return bytes(t for t in tokens if 0 <= t < 256).decode(
            "utf-8", errors="replace")
