"""Tokenizers for the port's genai-perf and its OpenAI front-end.

The port's own copy of ``client_tpu/genai_perf/tokenizer.py``. The
OpenAI front-end tokenizes with :class:`SyntheticTokenizer`, the
deterministic word-hash tokenizer. genai-perf's default is a real
byte-level BPE tokenizer bundled with the package (``assets/bpe8k.json``,
read with the HF ``tokenizers`` library), giving subword token accounting
without any network access. A named HF tokenizer is used when its files
are available locally.
"""

import os
import zlib
from typing import List, Optional

DEFAULT_TOKENIZER = "hf-internal-testing/llama-tokenizer"
_BUNDLED_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "assets", "bpe8k.json"
)


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


class BundledBPETokenizer:
    """The in-repo byte-level BPE tokenizer (assets/bpe8k.json).

    A real subword tokenizer: merges learned by the standard BPE trainer,
    byte-level pre-tokenization (every input encodable, no OOV). Token
    counts behave like production LLM tokenizers (≈1.2-1.8 tokens/word on
    English prose) rather than the 1 token/word of the hash fallback.
    """

    def __init__(self, path: str = _BUNDLED_PATH):
        from tokenizers import Tokenizer

        self._tok = Tokenizer.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def decode(self, ids) -> str:
        return self._tok.decode(list(ids))

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}


def get_tokenizer(name: Optional[str] = None, vocab_size: int = 32000):
    """Resolve a tokenizer by name.

    - None/""/"bpe"/"default": the bundled BPE (real subword counting);
    - "synthetic": the crc32 word-hash fallback;
    - anything else: HF AutoTokenizer with local files, falling back to
      the bundled BPE (with a warning) when unavailable.
    """
    import sys

    def _tagged(tok, provenance):
        # Provenance rides with the tokenizer so metrics output can state
        # WHICH tokenizer produced the token counts: bundled-BPE counts
        # against real Llama endpoints are systematically off, and the
        # output must say so.
        try:
            tok.ctpu_provenance = provenance
        except Exception:  # noqa: BLE001 - exotic tokenizer classes
            pass
        return tok

    if name == "synthetic":
        return _tagged(SyntheticTokenizer(vocab_size), "synthetic-word-hash")
    if name in (None, "", "bpe", "default"):
        try:
            return _tagged(BundledBPETokenizer(), "bundled-bpe8k")
        except Exception as e:  # noqa: BLE001 - tokenizers lib missing
            print(
                f"genai-perf: warning: bundled BPE unavailable ({e}); "
                "falling back to the synthetic word-hash tokenizer",
                file=sys.stderr,
            )
            return _tagged(
                SyntheticTokenizer(vocab_size), "synthetic-word-hash"
            )
    try:
        from transformers import AutoTokenizer

        return _tagged(
            AutoTokenizer.from_pretrained(name, local_files_only=True),
            f"hf:{name}",
        )
    except Exception as e:  # noqa: BLE001 - offline environments
        print(
            f"genai-perf: warning: could not load tokenizer '{name}' "
            f"({e}); using the bundled BPE tokenizer — counts are real "
            "subword counts but not identical to the requested tokenizer",
            file=sys.stderr,
        )
        return get_tokenizer("bpe", vocab_size)


def tokenizer_provenance(tokenizer) -> str:
    """The provenance tag get_tokenizer attached (or a best guess)."""
    return getattr(
        tokenizer, "ctpu_provenance", type(tokenizer).__name__
    )
