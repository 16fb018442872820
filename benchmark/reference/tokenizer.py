"""The word-hash tokenizer of the OpenAI route, kept with the benchmark.

The served chat route turns each whitespace-separated word into one id,
``crc32(word) % (vocab - 2) + 2``, and writes each generated id back as
the word ``tok<id>``. The reference re-derives the prompt's ids with
this copy, so a change of the program's tokenizer shows as a wrong
answer instead of moving the yardstick with it.
"""

import zlib
from typing import List


def encode(text: str, vocab_size: int) -> List[int]:
    """The ids of ``text``: one a word; ids 0 and 1 never occur."""
    return [(zlib.crc32(word.encode("utf-8")) % (vocab_size - 2)) + 2
            for word in text.split()]


def decode_ids(text: str) -> List[int]:
    """The ids of served text: each word is ``tok<id>``. Raises on a word
    of another form."""
    ids = []
    for word in text.split():
        if not word.startswith("tok") or not word[3:].isdigit():
            raise ValueError(f"served word {word!r} is not tok<id>")
        ids.append(int(word[3:]))
    return ids
