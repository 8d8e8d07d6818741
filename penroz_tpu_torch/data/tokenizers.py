"""The ``byte`` tokenizer (copy of penroz_tpu/data/tokenizers.py): raw
UTF-8 bytes + an EOT id, offline and dependency-free.  The other backends
(``tiktoken/…``, ``bpe:…``, HuggingFace names) need downloads or modules
the port does not carry, so they raise ValueError (→ HTTP 400)."""

from __future__ import annotations

BYTE_EOT = 256


class Tokenizer:
    def __init__(self, encoding: str):
        if encoding != "byte":
            raise ValueError(f"encoding {encoding!r} is not available in "
                             f"penroz_tpu_torch; use 'byte'")
        self.encoding = encoding

    def tokenize(self, text: str) -> list[int]:
        return list(text.encode()) + [BYTE_EOT]

    def decode(self, tokens) -> str:
        return bytes(t for t in tokens if 0 <= t < 256).decode(
            "utf-8", errors="replace")
