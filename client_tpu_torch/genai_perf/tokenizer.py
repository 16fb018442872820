"""The deterministic word-hash tokenizer the OpenAI front-end uses."""

import zlib
from typing import List


class SyntheticTokenizer:
    """Deterministic word-hash tokenizer: 1 word -> 1 token id.

    Uses crc32 rather than ``hash()`` so ids are stable across interpreter
    processes (PYTHONHASHSEED randomizes str hashing). Ids 0 and 1 are
    never produced.
    """

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [
            (zlib.crc32(word.encode("utf-8")) % (self.vocab_size - 2)) + 2
            for word in text.split()
        ]

    def decode(self, ids) -> str:
        return " ".join(f"tok{i}" for i in ids)

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}
